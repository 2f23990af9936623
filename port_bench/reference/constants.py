"""TransmogrifAI's published defaults that the reference follows (the
upstream Scala sources' values, as their documentation states them)."""

# Transmogrifier (TransmogrifierDefaults.scala:52-87)
TOP_K = 20
MIN_SUPPORT = 10
# label-aware bucketizing of each numeric feature
# (DecisionTreeNumericBucketizer.scala: a shallow tree, 32 bins)
BUCKET_MAX_DEPTH = 4
BUCKET_MAX_BINS = 32
BUCKET_MIN_INFO_GAIN = 0.01
BUCKET_MIN_INSTANCES = 1

# SanityChecker (SanityChecker.scala:59-225)
MIN_VARIANCE = 1e-5
MIN_CORRELATION = 0.0
MAX_CORRELATION = 0.95
MAX_CRAMERS_V = 0.95
MAX_RULE_CONFIDENCE = 1.0
MIN_RULE_SUPPORT = 0.3

# holdout and folds (Splitter.scala:57, OpCrossValidation.scala)
SPLIT_SEED = 42

# logistic regression: Newton / IRLS with Spark's standardization, the L1
# part of the elastic net by iterated reweighting, a fixed step count
LR_ITERS = 25
LR_L1_SMOOTH = 1e-3
LR_EPS = 1e-8

# gradient-boosted trees (MLlib GradientBoostedTrees: logistic loss,
# stepSize 0.1; maxBins 32; minInstancesPerNode 1)
GBT_STEP = 0.1
GBT_MAX_BINS = 32
GBT_MIN_INSTANCES = 1
# quantile edges from a row sample above this many rows (Spark's
# findSplits sketch)
EDGE_SAMPLE_CAP = 1 << 19
EDGE_SEED = 42

# device rank metrics: 1 024 score bins from this many training rows on a
# card, for the linear family's AuROC
RANK_BINS = 1024
APPROX_RANK_MIN_ROWS = 100_000
