"""The general part of the benchmark: finding a cell's files, the import
guard, the measured window, the device trace and the result line."""
