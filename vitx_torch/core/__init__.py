"""Configuration and device selection of the port."""
