"""Weight bridge, losses, metrics and plots of the port."""
