"""Scalar helpers, device selection and NumPy conversion."""
