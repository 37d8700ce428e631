"""GeekModel checkpoints in the reference's format."""
