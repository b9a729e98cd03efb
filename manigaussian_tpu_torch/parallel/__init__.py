"""Multi-device training over `torch.distributed`: the rendezvous and the
collectives (`distributed`), the mesh of ranks (`mesh`), the tile-sharded
splat renderer (`rasterizer_sharded`) and the data-parallel step
(`train_sharded`)."""
