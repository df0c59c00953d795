"""Models of the port: ResNet-20 (the paper's test model)."""
