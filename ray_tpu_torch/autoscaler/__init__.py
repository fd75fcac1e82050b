"""The port's autoscaler seam (counterpart: ``ray_tpu/autoscaler``): so
far ``node_provider``'s replica-capacity providers, which the serve
pool's autoscaler (serve/pool_autoscaler.py) requests capacity from.
The reference's cluster node providers, its TPU slice provider and its
simulated TPU cloud wait for the cloud provider (ROADMAP.md, queue 1,
item 13); this package re-exports nothing.
"""
