"""Model modules of the port: layers, attention, the ViT forward."""
