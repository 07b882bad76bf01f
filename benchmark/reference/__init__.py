"""The plain reference (float64) the checks compare with; imports nothing
of the program."""
