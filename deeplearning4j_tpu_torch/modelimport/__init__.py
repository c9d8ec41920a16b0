"""Framework model import: TensorFlow GraphDefs into SameDiff."""
