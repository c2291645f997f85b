// Native host-side kernels for mhmocap.
//
// The reference implementation leans on third-party native code for
// its host-side hot loops (scipy's C++ linear_sum_assignment for
// Hungarian matching, utils.py:278-311; and an O(H*W*k^2) *python*
// pixel loop for masked fill-in, utils.py:91-135, which dominates
// ingestion time there). This extension provides both as C++ with a
// plain CPython C-API binding (no pybind11 in the image):
//
//   fillin_values(x, mask, filter_size, metric) -> (new_x, new_mask)
//       One iteration of masked neighborhood fill-in over a float32
//       (H, W) or (H, W, C) array. metric: 0=median 1=mean 2=max 3=min.
//
//   hungarian(cost) -> (row_idx, col_idx)
//       Optimal assignment on a float64 (R, C) cost matrix via the
//       Jonker-Volgenant shortest-augmenting-path algorithm (O(n^3)),
//       same contract as scipy.optimize.linear_sum_assignment.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <algorithm>
#include <cmath>
#include <limits>
#include <vector>

namespace {

float apply_metric(std::vector<float>& vals, int metric) {
  if (vals.empty()) return 0.f;
  switch (metric) {
    case 0: {  // median (numpy semantics: mean of middle two)
      std::sort(vals.begin(), vals.end());
      size_t n = vals.size();
      if (n % 2 == 1) return vals[n / 2];
      return 0.5f * (vals[n / 2 - 1] + vals[n / 2]);
    }
    case 1: {  // mean
      double s = 0;
      for (float v : vals) s += v;
      return static_cast<float>(s / vals.size());
    }
    case 2: return *std::max_element(vals.begin(), vals.end());
    default: return *std::min_element(vals.begin(), vals.end());
  }
}

PyObject* fillin_values(PyObject*, PyObject* args) {
  PyObject *x_obj, *mask_obj;
  int ksize, metric = 0;
  if (!PyArg_ParseTuple(args, "OOi|i", &x_obj, &mask_obj, &ksize,
                        &metric))
    return nullptr;

  PyArrayObject* x = reinterpret_cast<PyArrayObject*>(
      PyArray_FROM_OTF(x_obj, NPY_FLOAT32,
                       NPY_ARRAY_IN_ARRAY | NPY_ARRAY_ENSURECOPY));
  PyArrayObject* mask = reinterpret_cast<PyArrayObject*>(
      PyArray_FROM_OTF(mask_obj, NPY_FLOAT32,
                       NPY_ARRAY_IN_ARRAY | NPY_ARRAY_ENSURECOPY));
  if (!x || !mask) {
    Py_XDECREF(x);
    Py_XDECREF(mask);
    return nullptr;
  }
  int nd = PyArray_NDIM(x);
  if ((nd != 2 && nd != 3) || PyArray_NDIM(mask) != 2) {
    PyErr_SetString(PyExc_ValueError,
                    "x must be (H,W[,C]) and mask (H,W)");
    Py_DECREF(x);
    Py_DECREF(mask);
    return nullptr;
  }
  npy_intp H = PyArray_DIM(x, 0), W = PyArray_DIM(x, 1);
  npy_intp Cc = nd == 3 ? PyArray_DIM(x, 2) : 1;
  float* xd = static_cast<float*>(PyArray_DATA(x));
  float* md = static_cast<float*>(PyArray_DATA(mask));

  // Read from the ORIGINAL mask/values (the reference updates nx in
  // place but tests the original mask, utils.py:112-135).
  std::vector<float> x0(xd, xd + H * W * Cc);
  std::vector<float> m0(md, md + H * W);
  int k = ksize / 2;
  std::vector<float> vals;
  vals.reserve(ksize * ksize);

  for (npy_intp r = 0; r < H; ++r) {
    for (npy_intp c = 0; c < W; ++c) {
      if (m0[r * W + c] > 0.5f) continue;
      npy_intp r1 = std::max<npy_intp>(0, r - k);
      npy_intp r2 = std::min<npy_intp>(H, r + k + 1);
      npy_intp c1 = std::max<npy_intp>(0, c - k);
      npy_intp c2 = std::min<npy_intp>(W, c + k + 1);
      bool any = false;
      for (npy_intp ch = 0; ch < Cc; ++ch) {
        vals.clear();
        for (npy_intp rr = r1; rr < r2; ++rr)
          for (npy_intp cc = c1; cc < c2; ++cc)
            if (m0[rr * W + cc] > 0.5f)
              vals.push_back(x0[(rr * W + cc) * Cc + ch]);
        if (!vals.empty()) {
          any = true;
          xd[(r * W + c) * Cc + ch] = apply_metric(vals, metric);
        }
      }
      if (any) md[r * W + c] = 1.0f;
    }
  }

  PyObject* out = PyTuple_Pack(2, reinterpret_cast<PyObject*>(x),
                               reinterpret_cast<PyObject*>(mask));
  Py_DECREF(x);
  Py_DECREF(mask);
  return out;
}

// Shortest-augmenting-path Hungarian with potentials (square matrix,
// 1-based columns, column 0 is the virtual start).
void lapjv(int n, const std::vector<double>& cost,
           std::vector<int>& row_of_col) {
  const double INF = std::numeric_limits<double>::infinity();
  std::vector<double> u(n + 1, 0.0), v(n + 1, 0.0);
  std::vector<int> p(n + 1, 0), way(n + 1, 0);
  for (int i = 1; i <= n; ++i) {
    p[0] = i;
    int j0 = 0;
    std::vector<double> minv(n + 1, INF);
    std::vector<char> used(n + 1, false);
    do {
      used[j0] = true;
      int i0 = p[j0], j1 = 0;
      double delta = INF;
      for (int j = 1; j <= n; ++j) {
        if (used[j]) continue;
        double cur = cost[(i0 - 1) * n + (j - 1)] - u[i0] - v[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        if (minv[j] < delta) {
          delta = minv[j];
          j1 = j;
        }
      }
      for (int j = 0; j <= n; ++j) {
        if (used[j]) {
          u[p[j]] += delta;
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      j0 = j1;
    } while (p[j0] != 0);
    do {
      int j1 = way[j0];
      p[j0] = p[j1];
      j0 = j1;
    } while (j0);
  }
  row_of_col.assign(n, -1);
  for (int j = 1; j <= n; ++j) row_of_col[j - 1] = p[j] - 1;
}

PyObject* hungarian(PyObject*, PyObject* args) {
  PyObject* cost_obj;
  if (!PyArg_ParseTuple(args, "O", &cost_obj)) return nullptr;
  PyArrayObject* cost = reinterpret_cast<PyArrayObject*>(
      PyArray_FROM_OTF(cost_obj, NPY_FLOAT64, NPY_ARRAY_IN_ARRAY));
  if (!cost) return nullptr;
  if (PyArray_NDIM(cost) != 2) {
    PyErr_SetString(PyExc_ValueError, "cost must be 2-D");
    Py_DECREF(cost);
    return nullptr;
  }
  int R = static_cast<int>(PyArray_DIM(cost, 0));
  int C = static_cast<int>(PyArray_DIM(cost, 1));
  int n = std::max(R, C);
  const double* cd = static_cast<const double*>(PyArray_DATA(cost));

  // pad to square with a large-but-finite cost
  double maxc = 0.0;
  for (int i = 0; i < R * C; ++i)
    maxc = std::max(maxc, std::abs(cd[i]));
  double pad = maxc * 2.0 + 1.0;
  std::vector<double> sq(n * n, pad);
  for (int r = 0; r < R; ++r)
    for (int c = 0; c < C; ++c) sq[r * n + c] = cd[r * C + c];

  std::vector<int> row_of_col;
  lapjv(n, sq, row_of_col);

  std::vector<npy_intp> rows, cols;
  for (int j = 0; j < n; ++j) {
    int r = row_of_col[j];
    if (r >= 0 && r < R && j < C) {
      rows.push_back(r);
      cols.push_back(j);
    }
  }
  // sort by row for scipy-compatible output
  std::vector<size_t> order(rows.size());
  for (size_t k = 0; k < order.size(); ++k) order[k] = k;
  std::sort(order.begin(), order.end(),
            [&](size_t a, size_t b) { return rows[a] < rows[b]; });

  npy_intp m = static_cast<npy_intp>(rows.size());
  PyObject* r_arr = PyArray_SimpleNew(1, &m, NPY_INTP);
  PyObject* c_arr = PyArray_SimpleNew(1, &m, NPY_INTP);
  npy_intp* rd = static_cast<npy_intp*>(
      PyArray_DATA(reinterpret_cast<PyArrayObject*>(r_arr)));
  npy_intp* ccd = static_cast<npy_intp*>(
      PyArray_DATA(reinterpret_cast<PyArrayObject*>(c_arr)));
  for (size_t k = 0; k < order.size(); ++k) {
    rd[k] = rows[order[k]];
    ccd[k] = cols[order[k]];
  }
  Py_DECREF(cost);
  PyObject* out = PyTuple_Pack(2, r_arr, c_arr);
  Py_DECREF(r_arr);
  Py_DECREF(c_arr);
  return out;
}

PyMethodDef methods[] = {
    {"fillin_values", fillin_values, METH_VARARGS,
     "One masked neighborhood fill-in iteration."},
    {"hungarian", hungarian, METH_VARARGS,
     "Optimal linear-sum assignment (rows, cols)."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_native",
    "Native host kernels for mhmocap", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__native(void) {
  import_array();
  return PyModule_Create(&moduledef);
}
