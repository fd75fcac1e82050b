"""The port's fleet seam (counterpart: ``ray_tpu/serve/fleet``): so far
``wire`` (the JSON envelopes and typed errors) and ``transport``
(loopback, sockets, injected faults), which the cross-replica KV pull
(serve/kv_migration.py) speaks, and ``routing`` (replica selection and
the at-most-once resubmit guard), which the engine pool
(serve/engine_pool.py) runs. The directory, agent, router and the rest
of the reference's fleet wait for the fleet agent (ROADMAP.md, queue
1, item 9); this package re-exports nothing.
"""
