"""Driver plumbing and the stage tools of the port."""
