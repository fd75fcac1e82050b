"""The port's fleet seam (counterpart: ``ray_tpu/serve/fleet``): so far
only ``wire`` (the JSON envelopes and typed errors) and ``transport``
(loopback, sockets, injected faults), which the cross-replica KV pull
(serve/kv_migration.py) speaks. The directory, agent, router and the
rest of the reference's fleet wait for the engine pool and the fleet
agent (ROADMAP.md, queue 1, items 6 and 9); this package re-exports
nothing.
"""
