"""The plain reference: Python integers, NumPy and hashlib.  It imports
nothing of the program; it reads the program's outputs only to judge them."""
