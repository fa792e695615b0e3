"""The plain reference of the comparison that decides `correct`: numpy
only, and nothing of the program under test."""
