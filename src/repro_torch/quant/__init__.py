# Double-Duty bitplane quantization on the bitplane_matmul kernel.
