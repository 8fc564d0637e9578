"""Device ops of the port (transforms, distances)."""
