"""Seeded inputs: views, PNG bytes, view counts and arrival schedules.
Every module here but ``views`` uses the standard library and numpy
alone; ``loadgen`` uses the standard library alone."""
