from .sharded_io import load_sharded_pytree, save_sharded_pytree
