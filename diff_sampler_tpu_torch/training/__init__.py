"""Training loops of the port (AMED so far)."""
