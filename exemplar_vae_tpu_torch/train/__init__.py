"""Evaluation, generation and the eval-time loss terms of the port."""
