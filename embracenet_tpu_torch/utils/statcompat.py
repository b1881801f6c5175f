"""scipy.stats fallbacks (port of ``embracenet_tpu/utils/statcompat.py``):
exports ``chi2_sf``, ``norm_sf``, ``rankdata``, ``ranksums`` and
``wilcoxon`` with scipy-equivalent numerics.

scipy is preferred when importable (bit-identical to the reference's
`scipy.stats.kruskal` / `ranksums` / `wilcoxon` usage in
`BIOINF_tesi/data_pipe/utils.py:46-130` and `models/utils/utils.py:302-353`);
``EMBRACENET_NO_SCIPY=1`` forces the fallbacks without attempting the
import.  The fallbacks evaluate the special functions in float64 on the
CPU through ``torch.special`` (``gammaincc`` for the chi-squared survival
function, ``erfc`` for the normal's; the JAX package routes them through
``jax.scipy.special``), and implement the exact signed-rank null
distribution for small-n ``wilcoxon`` the same way scipy's ``mode='exact'``
does.
"""

from __future__ import annotations

import numpy as np

import os

try:  # pragma: no cover - exercised per-environment
    # EMBRACENET_NO_SCIPY=1 forces the fallbacks without attempting the
    # import — a partially broken scipy install can abort the process at
    # C-extension load, which no try/except can catch (the test conftest
    # sets this after a failed subprocess probe).
    if os.environ.get("EMBRACENET_NO_SCIPY"):
        raise ImportError("scipy disabled via EMBRACENET_NO_SCIPY")
    from scipy.stats import chi2 as _chi2
    from scipy.stats import norm as _norm
    from scipy.stats import rankdata, ranksums, wilcoxon

    def chi2_sf(x, df):
        return _chi2.sf(x, df=df)

    def norm_sf(x):
        return _norm.sf(x)

    HAVE_SCIPY = True
except Exception:  # OSError (broken install) or ImportError
    HAVE_SCIPY = False

    def chi2_sf(x, df):
        """Survival function of chi^2_df: regularized upper incomplete gamma
        Q(df/2, x/2), evaluated in float64."""
        import torch

        x = np.asarray(x, np.float64)
        half = torch.as_tensor(np.maximum(x, 0.0) / 2.0, dtype=torch.float64)
        out = torch.special.gammaincc(
            torch.full_like(half, df / 2.0), half).numpy()
        return np.where(x < 0, 1.0, out)

    def norm_sf(x):
        import torch

        z = torch.as_tensor(np.asarray(x, np.float64) / np.sqrt(2.0),
                            dtype=torch.float64)
        return torch.special.erfc(z).numpy() / 2.0

    def rankdata(a, method: str = "average", *, axis=None):
        """Average-tie ranks (the only method this package uses)."""
        if method != "average":
            raise NotImplementedError(method)
        a = np.asarray(a, np.float64)
        if axis is None:
            flat = rankdata(a.ravel(), axis=0)
            return flat.reshape(a.shape)
        a = np.moveaxis(a, axis, 0)
        n = a.shape[0]
        order = np.argsort(a, axis=0, kind="stable")
        sorted_a = np.take_along_axis(a, order, axis=0)
        # rank of each sorted position, tie groups averaged
        idx = np.arange(1, n + 1, dtype=np.float64)
        ranks_sorted = np.empty_like(sorted_a)
        # per-column tie averaging (vectorised over trailing dims via loop on
        # flattened columns — stats matrices here are [N, D] with modest D)
        flat = sorted_a.reshape(n, -1)
        rs = np.repeat(idx[:, None], flat.shape[1], axis=1)
        for j in range(flat.shape[1]):
            col = flat[:, j]
            # boundaries of tie runs
            new = np.empty(n, dtype=bool)
            new[0] = True
            new[1:] = col[1:] != col[:-1]
            grp = np.cumsum(new) - 1
            sums = np.bincount(grp, weights=idx)
            cnts = np.bincount(grp)
            rs[:, j] = (sums / cnts)[grp]
        ranks_sorted = rs.reshape(sorted_a.shape)
        out = np.empty_like(ranks_sorted)
        np.put_along_axis(out, order, ranks_sorted, axis=0)
        return np.moveaxis(out, 0, axis)

    class _TestResult(tuple):
        @property
        def statistic(self):
            return self[0]

        @property
        def pvalue(self):
            return self[1]

    def ranksums(x, y, alternative: str = "two-sided"):
        """Wilcoxon rank-sum (scipy.stats.ranksums: normal approximation,
        no tie correction)."""
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        n1, n2 = len(x), len(y)
        allr = rankdata(np.concatenate([x, y]), axis=0)
        s = allr[:n1].sum()
        expected = n1 * (n1 + n2 + 1) / 2.0
        z = (s - expected) / np.sqrt(n1 * n2 * (n1 + n2 + 1) / 12.0)
        if alternative == "two-sided":
            p = 2.0 * norm_sf(abs(z))
        elif alternative == "greater":
            p = norm_sf(z)
        elif alternative == "less":
            p = float(1.0 - norm_sf(z))
        else:
            raise ValueError(alternative)
        return _TestResult((float(z), float(min(p, 1.0))))

    def wilcoxon(x, y=None, alternative: str = "two-sided"):
        """Signed-rank test, scipy defaults: zero-differences dropped
        (``zero_method='wilcox'``), exact null for n <= 25 without ties,
        normal approximation with tie correction otherwise."""
        d = np.asarray(x, np.float64)
        if y is not None:
            d = d - np.asarray(y, np.float64)
        d = d[d != 0]
        n = len(d)
        if n == 0:
            return _TestResult((np.nan, np.nan))
        r = rankdata(np.abs(d), axis=0)
        w_plus = float(r[d > 0].sum())
        w_minus = float(r[d < 0].sum())
        has_ties = len(np.unique(np.abs(d))) != n
        stat = min(w_plus, w_minus) if alternative == "two-sided" else w_plus
        if n <= 25 and not has_ties:
            # exact: enumerate all 2^n sign assignments' W+ distribution
            tot = n * (n + 1) // 2
            counts = np.zeros(tot + 1, dtype=np.float64)
            counts[0] = 1.0
            for k in range(1, n + 1):
                nxt = counts.copy()
                nxt[k:] += counts[:-k] if k else counts
                counts = nxt
            counts /= 2.0 ** n
            cdf = np.cumsum(counts)
            sf = np.cumsum(counts[::-1])[::-1]
            if alternative == "two-sided":
                p = 2.0 * cdf[int(round(stat))]
            elif alternative == "greater":
                p = sf[int(round(w_plus))]
            else:
                p = cdf[int(round(w_plus))]
            return _TestResult((stat, float(min(p, 1.0))))
        mn = n * (n + 1) / 4.0
        se2 = n * (n + 1) * (2 * n + 1) / 24.0
        _, tie_counts = np.unique(r, return_counts=True)
        se2 -= (tie_counts ** 3 - tie_counts).sum() / 48.0
        se = np.sqrt(se2)
        # scipy default correction=False: plain z, no continuity correction
        z = (stat - mn) / se
        if alternative == "two-sided":
            p = 2.0 * norm_sf(abs(z))
        elif alternative == "greater":
            p = norm_sf(z)
        else:
            p = float(1.0 - norm_sf(z))
        return _TestResult((stat, float(min(p, 1.0))))
