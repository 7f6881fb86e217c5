"""The plain reference: float32 PyTorch of the Llama-style decoder, TF32
off, with autograd for training. It imports nothing of the program."""
