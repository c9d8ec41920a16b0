from deeplearning4j_tpu_torch.evaluation.evaluation import (  # noqa: F401
    Evaluation, RegressionEvaluation, ROC, ROCBinary, ROCMultiClass,
    EvaluationBinary, EvaluationCalibration)
