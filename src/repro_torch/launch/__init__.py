"""Serving and launch entry points of the port."""
