"""Host-side IO of the port: the synthetic RGB-D scene generator and the
TUM trajectory writer."""
