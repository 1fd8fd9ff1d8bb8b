"""Runtime of the port: the LM serving loop."""
