"""Models the port trains: the paper CNN."""
