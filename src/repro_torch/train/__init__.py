# Training: loss, optimizers, the train step and the fault-tolerant loop.
