"""Port of ``ray_tpu/rl/learner.py``: the token-level policy-gradient
learner over engine rollout batches.

Reuses the rllib loss pieces on sequence data: ``algo="ppo"`` applies
``rllib.ppo.clipped_surrogate_loss`` with a per-sequence advantage
(reward minus a running scalar baseline, normalized across the batch)
broadcast to every completion token; ``algo="vtrace"`` applies
``rllib.impala.vtrace_returns`` per sequence (reward at the terminal
token, baseline as the constant value estimate) — the off-policy
correction that matters once rollouts lag the learner by a bounded
number of updates (rl/loop.py's staleness knob).

The model is ``models.llama.build_train_model``'s: fp32 masters, cast
to ``cfg.dtype`` at each use, trained by ``torch.optim.Adam`` (the
reference's ``optax.adam``). The forward is its cache-free pass, whose
attention (``attention_impl="auto"``) takes the flash kernels on the
card when the frozen length L is a multiple of 128. Logits at position
``plen-1+i`` score completion token ``i``. Behavior logprobs come from
the engine's capture (rollout.RolloutBatch), so the importance ratio
is exact even when the batch was sampled a few generations ago. Shapes
are frozen from the first batch; padding rides adv=0 / mask=0 so it
contributes exactly zero loss. The state dict's keys are the ones
``build_model`` and ``LLMEngine.swap_weights`` take, so a published
payload swaps straight into the generator.
"""
from __future__ import annotations

import copy
from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.llama import LlamaConfig, build_train_model
from ray_tpu_torch.rl.rollout import RolloutBatch
from ray_tpu_torch.rllib.impala import vtrace_returns
from ray_tpu_torch.rllib.ppo import clipped_surrogate_loss


def _to_host(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor leaf copied to the host."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return copy.deepcopy(tree)


class RolloutLearner:
    """``cfg`` and ``params`` (a state dict of the port's Llama) build
    the trained model on ``device`` (the card by default, ``"cpu"``
    when asked; raises ``NoCudaError`` without a card)."""

    def __init__(self, cfg: LlamaConfig, params: Dict[str, torch.Tensor],
                 *, algo: str = "ppo", lr: float = 1e-2,
                 clip_eps: float = 0.2, gamma: float = 1.0,
                 entropy_coef: float = 0.0, baseline_beta: float = 0.2,
                 sgd_epochs: int = 1, device=None):
        if algo not in ("ppo", "vtrace"):
            raise ValueError(f"unknown algo {algo!r}; expected 'ppo' "
                             f"or 'vtrace'")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_train_model(cfg, params, self.device)
        self.algo = algo
        self.clip_eps = float(clip_eps)
        self.gamma = float(gamma)
        self.entropy_coef = float(entropy_coef)
        self.baseline_beta = float(baseline_beta)
        self.sgd_epochs = max(1, int(sgd_epochs))
        self.baseline = 0.0
        self.update_count = 0
        self._opt = torch.optim.Adam(self.model.parameters(), lr=lr)
        self._shape = None          # (B, L, T) frozen on first update

    # ------------------------------------------------------------ loss

    def _loss(self, b: Dict[str, torch.Tensor]):
        logits = self.model(b["tokens"])                     # [B, L, V]
        V = logits.shape[-1]
        sel = logits.float().gather(
            1, b["gpos"][:, :, None].expand(-1, -1, V))      # [B, T, V]
        logp_all = torch.log_softmax(sel, dim=-1)
        logp = logp_all.gather(-1, b["targets"][:, :, None])[..., 0]
        mask = b["mask"]
        denom = torch.clamp(mask.sum(), min=1.0)
        if self.algo == "ppo":
            adv_tok = b["adv"][:, None] * mask               # pad -> 0 loss
            pg = clipped_surrogate_loss(
                logp.reshape(-1), b["behavior"].reshape(-1),
                adv_tok.reshape(-1), self.clip_eps)
        else:
            rho = torch.exp(logp.detach() - b["behavior"]) * mask
            values = torch.full_like(logp, b["baseline"])
            _vs, pg_adv = vtrace_returns(values, 0.0, b["rew_tok"],
                                         b["dones"], rho, gamma=self.gamma)
            pg = -(mask * logp * pg_adv).sum() / denom
        ent = -(mask[:, :, None] * torch.exp(logp_all) *
                logp_all).sum() / denom
        return pg - self.entropy_coef * ent, pg, ent

    # ------------------------------------------------------------ host

    def _pack(self, batch: RolloutBatch) -> Dict[str, Any]:
        rewards = batch.rewards
        if rewards is None:
            raise ValueError(
                f"batch {batch.batch_id} is unscored (rewards=None)")
        B = batch.num_samples()
        if self._shape is None:
            L = max(len(p) + len(c) for p, c in
                    zip(batch.prompts, batch.completions))
            T = max(max(len(c) for c in batch.completions), 1)
            self._shape = (B, L, T)
        eB, L, T = self._shape
        if B != eB:
            raise ValueError(f"batch size changed: {B} != {eB}")
        tokens = np.zeros((B, L), np.int64)
        gpos = np.zeros((B, T), np.int64)
        targets = np.zeros((B, T), np.int64)
        behavior = np.zeros((B, T), np.float32)
        mask = np.zeros((B, T), np.float32)
        rew_tok = np.zeros((B, T), np.float32)
        dones = np.zeros((B, T), np.float32)
        for i, (p, c, lp) in enumerate(zip(batch.prompts,
                                           batch.completions,
                                           batch.logprobs)):
            if len(lp) != len(c):
                raise ValueError(
                    f"batch {batch.batch_id} sample {i}: {len(lp)} "
                    f"logprobs for {len(c)} tokens — was the engine "
                    f"built with capture_logprobs=True?")
            seq = list(p) + list(c)
            if len(seq) > L or len(c) > T:
                raise ValueError(
                    f"sample {i} exceeds frozen shape (L={L}, T={T})")
            tokens[i, :len(seq)] = seq
            n = len(c)
            gpos[i, :n] = np.arange(len(p) - 1, len(p) - 1 + n)
            targets[i, :n] = c
            behavior[i, :n] = lp
            mask[i, :n] = 1.0
            if n:
                rew_tok[i, n - 1] = rewards[i]
                dones[i, n - 1] = 1.0
        rew = np.asarray(rewards, np.float32)
        base = self.baseline if self.update_count else float(rew.mean())
        adv = rew - base
        # numpy's std is the population std (ddof 0), as the reference's
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)
        out = {k: torch.from_numpy(v).to(self.device) for k, v in (
            ("tokens", tokens), ("gpos", gpos), ("targets", targets),
            ("behavior", behavior), ("mask", mask),
            ("adv", adv.astype(np.float32)), ("rew_tok", rew_tok),
            ("dones", dones))}
        out["baseline"] = float(np.float32(base))
        return out

    def update(self, batch: RolloutBatch) -> Dict[str, Any]:
        """One policy-gradient update on a scored rollout batch:
        ``sgd_epochs`` Adam steps on the one packed batch."""
        packed = self._pack(batch)
        # Multiple epochs over the same batch is standard PPO — the
        # clipped ratio (against the FIXED behavior logprobs) is what
        # keeps later epochs from running away from the sampler.
        for _ in range(self.sgd_epochs):
            self._opt.zero_grad(set_to_none=True)
            loss, pg, ent = self._loss(packed)
            loss.backward()
            self._opt.step()
        rew_mean = float(np.mean(batch.rewards))
        beta = self.baseline_beta
        self.baseline = (rew_mean if self.update_count == 0
                         else (1 - beta) * self.baseline +
                         beta * rew_mean)
        self.update_count += 1
        return {
            "update": self.update_count,
            "loss": loss.item(),
            "pg_loss": pg.item(),
            "entropy": ent.item(),
            "reward_mean": rew_mean,
            "baseline": self.baseline,
            "num_tokens": batch.num_tokens(),
        }

    # ----------------------------------------------------------- state

    def host_params(self) -> Dict[str, torch.Tensor]:
        """Host copies of the model's state dict (fp32 masters): the
        payload ``publish_weights`` and ``swap_weights`` take."""
        return _to_host(self.model.state_dict())

    def get_state(self) -> Dict[str, Any]:
        """Host copies of the params and the Adam state: torch updates
        both in place, so a state that aliased them would change under
        a later update."""
        return {
            "params": self.host_params(),
            "opt_state": _to_host(self._opt.state_dict()),
            "baseline": self.baseline,
            "update_count": self.update_count,
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        with torch.no_grad():
            self.model.load_state_dict(state["params"])
        self._opt.load_state_dict(state["opt_state"])
        self.baseline = float(state["baseline"])
        self.update_count = int(state["update_count"])
