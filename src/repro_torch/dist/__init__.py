"""dist (PyTorch port of ``repro/dist``): the sharding rules and each
rank's shard (``sharding``), and the explicit collectives over a gloo
group (``collectives``) of tensor-parallel serving."""
