"""Layers under the ViT: attention, embeddings, norms, encoder blocks."""
