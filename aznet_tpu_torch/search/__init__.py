"""The adjacency-and-zoom search."""
