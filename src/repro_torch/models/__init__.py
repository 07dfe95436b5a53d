# The LM substrate for the dense family: primitives (layers), per-layer
# bodies (blocks), assembly (lm) and weight conversion (convert).
