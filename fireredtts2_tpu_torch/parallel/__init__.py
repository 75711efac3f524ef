"""Multi-GPU serving: the (dp, tp) mesh, placement rules and collectives."""
