"""Scene generators, frozen copies of the program's presets."""
