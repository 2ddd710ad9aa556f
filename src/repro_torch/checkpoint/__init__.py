from repro_torch.checkpoint.store import CheckpointStore, leaf_files

__all__ = ["CheckpointStore", "leaf_files"]
