"""Training infrastructure shared by the port's trainers."""
