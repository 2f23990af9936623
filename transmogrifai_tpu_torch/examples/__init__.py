"""Example apps (the reference's helloworld counterparts) and the
synthetic benchmark data.  Each app builds its workflow on a ``device``,
the card by default:

* ``titanic``, ``boston``, ``iris`` - the binary, regression and
  multiclass apps over their CSVs;
* ``joins_and_aggregates``, ``conditional_aggregation`` - the data-prep
  apps over event tables built in code;
* ``synthetic`` - the planted-truth passenger data, on the host or
  generated on the card.
"""
from .boston import boston_workflow, load_boston
from .conditional_aggregation import conditional_aggregation_workflow
from .iris import iris_workflow, load_iris
from .joins_and_aggregates import joins_and_aggregates_workflow
from .titanic import titanic_features, titanic_reader, titanic_workflow

__all__ = [
    "boston_workflow",
    "conditional_aggregation_workflow",
    "iris_workflow",
    "joins_and_aggregates_workflow",
    "load_boston",
    "load_iris",
    "titanic_features",
    "titanic_reader",
    "titanic_workflow",
]
