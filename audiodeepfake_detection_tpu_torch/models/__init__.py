"""Models: the DCNN family as ``nn.Module``s, and checkpoint import/export."""
