# Deterministic synthetic token pipeline.
