"""Network modules of the port (NCHW activations, OIHW weights)."""
