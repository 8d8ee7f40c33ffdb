"""sql_plan_ms: the mean of the `sql` spans, around `session.sql(text)`
(parse and logical plan in the client), over the statements completed in
the traced window. Layer: client and SQL planner."""


def read(w):
    if not w.queries:
        return None
    return 1e3 * sum(q.planned - q.submit for q in w.queries) / len(w.queries)
