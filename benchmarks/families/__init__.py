"""The program's dense model of each family at a configuration's sizes."""
