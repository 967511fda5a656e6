"""Plain references that decide ``correct``: plain PyTorch and NumPy, with
nothing imported from the port and nothing taken that the port made."""
