"""Architecture configs; each module registers itself on import."""
