"""Model zoo of the port (the paper's CNNs; ResNet-50 so far)."""
