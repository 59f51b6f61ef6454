"""Models of the port: layers, U-Nets, preconditioners, text towers, factory,
checkpoint loader and zoo, converter."""
