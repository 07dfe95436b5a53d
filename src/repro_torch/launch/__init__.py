# Command-line entry points: serve, quantized_serve, train.
