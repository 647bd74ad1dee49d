"""Crop embedders: the ViT trunk (with the CUDA attention kernel) and the
weights-free test embedders."""
