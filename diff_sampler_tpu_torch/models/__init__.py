"""Models of the port: layers, SongUNet, EDMPrecond, factory, converter."""
