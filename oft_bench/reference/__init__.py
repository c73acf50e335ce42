"""The plain reference of the gesture tracker (``plain.py``) and its
streaming replay (``stream.py``): plain PyTorch and NumPy, float32 with
TF32 off, importing nothing of the program, of JAX or of the JAX package.
"""
