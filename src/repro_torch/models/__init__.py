"""Models of the port: the paper's CapsNet."""
