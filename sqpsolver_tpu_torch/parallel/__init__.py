"""parallel of the PyTorch port: instance batching (``batch``), multi-device
solves in one process (``sharding``) and one process per GPU on
``torch.distributed`` (``multihost``)."""
