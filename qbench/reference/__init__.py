"""Plain NumPy models of the structures' answers.

They import nothing of the program under test: they work out every
answer again from the generated inputs alone.
"""
