"""Model configuration, layers and assembly for the paged decode path."""
