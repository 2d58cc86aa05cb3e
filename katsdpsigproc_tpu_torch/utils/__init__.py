"""Support code for the port (the kernel builder and loader)."""
