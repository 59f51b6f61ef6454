"""Integrations of the port with other tools: the AMED schedule exporter and a numpy emulation of the reference's diffusers AMED scheduler."""
