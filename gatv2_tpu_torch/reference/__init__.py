"""Plain references that the port is held to: straightforward PyTorch,
independent of the port's code."""
