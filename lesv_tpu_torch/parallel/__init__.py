"""Multi-device (mesh) and multi-host (dist) paths of the port."""
