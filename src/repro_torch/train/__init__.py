"""Training substrate; this slice ports only the batch transfer."""
