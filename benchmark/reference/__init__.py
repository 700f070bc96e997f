"""The plain reference of the benchmark: the DM-NeRF field, its volume
rendering and its training step in float32 PyTorch (TF32 off), written from
the method's description and imported by nothing of the program, nor
importing it."""
