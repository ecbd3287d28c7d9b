"""Plain references of the port's benchmark: plain PyTorch and NumPy,
float32 or exact integers, TF32 off.  They import nothing of the program
and take nothing it made: each works its inputs out again from the bf16
weights and activations that the benchmark made from the seed."""
