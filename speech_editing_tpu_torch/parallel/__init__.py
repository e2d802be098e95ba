"""Data and tensor parallelism over ``torch.distributed``: the process
groups and the global batch (``mesh``), parameter splitting (``tp``) and
the multi-rank dry run (``dryrun``)."""
