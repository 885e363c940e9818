"""Policy CI decision corpus (docs/policy_ci.md).

The replay pregate judges a reconcile against *yesterday's traffic* —
a policy edit on a rule traffic never exercises sails through unchecked.
This package closes that hole with a coverage-guided decision corpus:

- ``store``      — the long-retention corpus container (pickle-free
                   checksummed format, ``.atpucorp`` suffix) and the pinned
                   corpus-row shape;
- ``distill``    — fold capture segments / the live capture ring into
                   distinct decision rows deduplicated by the
                   canonical row key, each carrying a frequency weight,
                   first/last-seen, and firing attribution;
- ``synthesize`` — per-(config, rule, evaluator-column) coverage against
                   the corpus's fired set, then truth-table inversion of
                   the bounded atom model into concrete request
                   documents that make each never-fired rule the
                   first-false attributed column (sound-not-complete;
                   uncoverable rules carry typed reason codes);
- ``pregate``    — the frequency-weighted corpus replay judged against the
                   canary's GuardThresholds (engine ``--corpus-pregate``);
- ``bisect``     — re-decide the corpus across a published snapshot chain
                   and name the exact generation that introduced each flip
                   (``analysis --corpus-diff``).
"""

from .store import (  # noqa: F401
    CORPUS_FIELDS,
    CORPUS_SCHEMA,
    CORPUS_SUFFIX,
    CorpusFormatError,
    read_corpus,
    read_corpus_file,
    write_corpus,
)
from .distill import distill_records  # noqa: F401
from .synthesize import (  # noqa: F401
    SYNTH_REASONS,
    coverage_report,
    synthesize_rows,
)
from .pregate import (  # noqa: F401
    CORPUS_PREGATE_ANOMALY,
    corpus_preflight,
    replay_corpus,
)
from .bisect import corpus_diff, load_generation_chain  # noqa: F401
