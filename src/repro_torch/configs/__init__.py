"""Model configurations the port runs, and its arch registry."""
