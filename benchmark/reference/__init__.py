"""The plain f32 PyTorch reference that decides `correct`. It imports
nothing of the program and takes nothing the program computed."""
