"""Hermetic data for the port: synthetic images and eval binarization."""
