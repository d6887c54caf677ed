"""Graph container, dataset IO and synthetic generators (numpy, host side)."""
