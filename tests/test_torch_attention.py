"""ray_tpu_torch.ops.attention against ray_tpu.ops.attention on the
CPU: the reference's ``impl="xla"`` (its dense einsum path) and the
port's ``impl="xla"``, the same seeded numpy inputs on both sides,
fp32, causal and not, with and without a padding bias. Tolerance 1e-5
abs and rel: both take the same einsum, scale, mask and fp32 softmax,
and differ only in summation order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jatt
from ray_tpu_torch.ops import attention as tatt

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("with_bias", [False, True])
def test_xla_impl_matches_reference(causal, with_bias):
    g = np.random.default_rng(11 + 2 * causal + with_bias)
    B, T, H, D = 2, 48, 3, 16
    q, k, v = (g.standard_normal((B, T, H, D)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((B, T), np.int32)
    mask[0, 40:] = 0                   # row 0 padded after 40 tokens
    mask[1, 29:] = 0
    jbias = jatt.padding_bias(jnp.asarray(mask)) if with_bias else None
    tbias = tatt.padding_bias(torch.from_numpy(mask)) if with_bias else None
    want = jatt.multi_head_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     impl="xla", bias=jbias)
    got = tatt.multi_head_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                    causal=causal, impl="xla", bias=tbias)
    assert got.dtype == torch.float32 and got.shape == (B, T, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # "xla" is the port's dense path under the reference's name
    dense = tatt.multi_head_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        impl="dense", bias=tbias)
    torch.testing.assert_close(got, dense, rtol=0, atol=0)
