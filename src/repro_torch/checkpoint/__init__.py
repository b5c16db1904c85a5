from repro_torch.checkpoint.checkpoint import load_pytree, save_pytree
