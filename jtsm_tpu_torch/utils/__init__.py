"""Training metrics (``events``) and seeding (``env``)."""
