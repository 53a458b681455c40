"""Model families of the port: SAM, DINOv2, the matcher."""
