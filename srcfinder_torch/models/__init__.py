"""GoogLeNet-1ch, its FCN head and the weight converter."""
