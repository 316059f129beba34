"""Scale-out: the scene farm, the ``("data", "model")`` mesh over a
``torch.distributed`` process group, and its dry run."""
