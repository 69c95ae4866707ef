"""Erasure coding: the plugin contract, coding matrices, the torch plugin and its registry."""
