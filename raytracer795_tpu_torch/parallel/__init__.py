"""Differentiable scene parameters and the inverse-rendering train step."""
