"""Augmentation ops and policies of the port."""
