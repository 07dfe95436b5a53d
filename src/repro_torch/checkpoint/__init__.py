# Checkpoints on the reference's on-disk format.
