"""Tensor functions of the port: preprocessing, densities, the exemplar
prior and its pairwise-LSE kernel, distances."""
