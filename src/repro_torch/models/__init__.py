"""Models of the port: the paper CNN and the dense-attention decoder LM."""
