"""The plain reference: Whisper and AdamW in plain PyTorch, float32 with
TF32 off.  Imports nothing of the program, of JAX or of the JAX package."""
