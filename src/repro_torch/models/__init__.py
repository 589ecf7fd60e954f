"""Tower runtime of the port: layers, precision policy, vision frontend,
attention backends, the encoder trunk and the BASIC dual encoder."""
