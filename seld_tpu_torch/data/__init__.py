"""Data for the port: seeded synthetic Task-2 features and targets."""
