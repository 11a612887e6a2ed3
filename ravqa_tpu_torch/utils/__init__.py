from .tables import (build_prediction_table, log_prediction_table,
                     save_prediction_table, table_columns)

__all__ = ["build_prediction_table", "log_prediction_table",
           "save_prediction_table", "table_columns"]
