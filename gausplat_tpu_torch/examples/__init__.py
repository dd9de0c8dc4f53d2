"""End-user workflows of the port, runnable as modules."""
