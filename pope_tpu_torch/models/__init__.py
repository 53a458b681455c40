"""Model families of the port (SAM so far)."""
