"""The reference tracking step and local BA."""
