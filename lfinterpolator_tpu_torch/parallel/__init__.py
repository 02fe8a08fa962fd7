"""Multi-GPU rendering over a (view x space) ``torch.distributed`` mesh:
``distributed`` starts the process group, ``mesh`` builds the mesh and
renders one rank's shard."""
