"""The 1D row partitioner and the 2D grid planner."""
