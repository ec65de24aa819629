"""Tree checkpoints in the JAX package's file format (counterpart of
`repro.checkpoint`)."""
from repro_torch.checkpoint.io import (load_checkpoint, read_checkpoint,
                                       save_checkpoint, treedef_str)

__all__ = ["load_checkpoint", "read_checkpoint", "save_checkpoint",
           "treedef_str"]
