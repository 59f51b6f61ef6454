"""Training loops of the port: AMED and SFD distillation."""
