"""Kernel B6: the row-sparse dist gather and its plain versions."""
