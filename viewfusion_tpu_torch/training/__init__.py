"""Training of the port: the learning-rate schedule and the train step."""
