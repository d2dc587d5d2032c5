"""The benchmark's harness: finds a cell's files by name, makes its inputs
from the seed, drives the port, traces the window and judges the outputs
against the plain reference."""
