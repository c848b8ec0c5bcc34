"""The LM model stack: layers, attention, transformer blocks, factory."""
